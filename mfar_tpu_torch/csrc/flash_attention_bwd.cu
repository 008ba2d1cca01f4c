// Kernel K2b: the backward of kernel K2 (flash_attention.cu), written for
// Hopper (sm_90a).  Two kernels, as the TPU has:
//
//   dkv: dV = P^T dO,  dK = dS^T Q        (one block per 64-key tile)
//   dq:  dQ = dS K                        (one block per 64-query tile)
//
// with  P  = exp(Q K^T * sm_scale - lse)  on same-segment pairs, 0 elsewhere,
//       dS = P * (dO V^T - di) * sm_scale, di = sum_d O * dO (f32),
// lse the forward's row logsumexp (natural units, written by K2 under
// training).  q/k/v/dO are bf16 [B, H, S, 64] read through their strides
// (D contiguous), seg int32 [B, S], lse and di contiguous f32 [B, H, S]; the
// gradients are bf16 (q's dtype, as JAX writes them) into [B, H, S, 64]
// views with their own strides, so the encoder's head split costs no copy.
//
// Replaces the two Pallas kernels of the VJP of JAX's library
// flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py,
// jax 0.9.0): _flash_attention_bwd_dkv (pl.pallas_call at :1121, body
// _flash_attention_dkv_kernel :796) and _flash_attention_bwd_dq (:1456,
// body :1146), reached when mfar_tpu/models/encoder.py:170 is
// differentiated.  The TPU kernels walk a sequential grid and carry dK/dV
// (or dQ) in scratch memory from one grid step to the next; here each block
// loops over the other axis itself and keeps its sums in registers, so no
// block writes what another writes: no atomics, and the gradients are the
// same from run to run.  The ds output of the TPU's dq kernel (the gradient
// of an attention bias) is not computed: the encoder passes no bias.
//
// Design (FlashAttention-2 style; simple and right first):
//   block = 4 warps, 16 rows each (keys in dkv, queries in dq), 64 rows.
//   dkv: the block's K and V tiles stay in shared memory; Q and dO tiles of
//        64 queries, with their lse, di and segment ids, are double-buffered
//        with cp.async.  Per query tile each warp recomputes S^T = K Q^T,
//        P^T, dV += P^T dO, dP^T = V dO^T, dS^T and dK += dS^T Q.
//   dq:  the block's Q and dO tiles are loaded once as mma A fragments; K
//        and V tiles with their segment ids are double-buffered.  Per key
//        tile: S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//   Every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands
//   from XOR-swizzled shared memory through ldmatrix (.trans where the
//   tile is B's k rows).  P and dS are rounded to bf16 for the products
//   they feed, as the TPU kernels do.  Shared memory is dynamic (~50 KB a
//   block, above the 48 KB of static shared memory).
//
// Masking: JAX adds its finite mask value and relies on exp underflowing;
// here a cross-segment entry of P (and so of dS) is set to exactly 0, so no
// masked logit is ever scaled (which would overflow in log2 units, as in
// K2) and no NaN can arise.  Every row has at least its own key, so lse is
// finite.  Not yet: wgmma, TMA, warp specialisation, skipping wholly masked
// tiles.
//
// What bounds it (at the training shape [96, 12, 512, 64] bf16): q/k/v/dO
// are 75.5 MB each.  dkv reads q, k, v, dO, lse, di and writes dK, dV:
// ~458 MB, 0.137 ms at 3.35 TB/s, against four products of 2*S*S*D per
// (b, h) = 155 GFLOP over all pairs, 0.157 ms at 989 TFLOP/s (bf16 dense).
// dq reads the same and writes dQ: ~382 MB, 0.114 ms, against three
// products, 116 GFLOP, 0.117 ms.  With ragged segments only same-segment
// pairs count, so the bytes bound them.

#include <climits>

#include "flash_common.cuh"

namespace {

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const int32_t* seg;
  const float* lse;  // [B, H, S]
  const float* di;   // [B, H, S]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  long long g_sb, g_sh, g_ss;  // strides of the gradients (one layout for all)
  int H, S;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

constexpr int kTileElems = kBlockN * kHeadDim;
// dkv: K, V, 2 x Q, 2 x dO tiles, then 2 x 64 lse, di and segment ids
constexpr int kDkvSmem = 6 * kTileElems * 2 + 3 * 2 * kBlockM * 4;
// dq: Q, dO, 2 x K, 2 x V tiles, then 2 x 64 segment ids
constexpr int kDqSmem = 6 * kTileElems * 2 + 2 * kBlockN * 4;

__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;    // [2] tiles
  __nv_bfloat16* do_s = q_s + 2 * kTileElems;  // [2] tiles
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // [2][64]
  float* di_s = lse_s + 2 * kBlockM;                                // [2][64]
  int32_t* seg_s = reinterpret_cast<int32_t*>(di_s + 2 * kBlockM);  // [2][64]

  const int tiles_n = p.S / kBlockN;
  const int n_tile = blockIdx.x % tiles_n;
  const int bh = blockIdx.x / tiles_n;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int key0 = n_tile * kBlockN;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseg = p.lse + static_cast<long long>(bh) * p.S;
  const float* dig = p.di + static_cast<long long>(bh) * p.S;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const int n_tiles = p.S / kBlockM;

  auto load_q_tile = [&](int t, int buf) {
    const long long row = static_cast<long long>(t) * kBlockM;
    load_tile(q_s + buf * kTileElems, qg + row * p.q_ss, p.q_ss, tid);
    load_tile(do_s + buf * kTileElems, dog + row * p.do_ss, p.do_ss, tid);
    load_row_values(lse_s + buf * kBlockM, lseg + row, tid);
    load_row_values(di_s + buf * kBlockM, dig + row, tid);
    load_row_values(seg_s + buf * kBlockM, segb + row, tid);
  };

  load_tile(k_s, p.k + b * p.k_sb + h * p.k_sh + key0 * p.k_ss, p.k_ss, tid);
  load_tile(v_s, p.v + b * p.v_sb + h * p.v_sh + key0 * p.v_ss, p.v_ss, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  // this thread's two keys: g and g + 8 of the warp's 16
  const int krow = key0 + warp * 16 + g;
  const int seg_k0 = segb[krow], seg_k1 = segb[krow + 8];

  float dk[8][4], dv[8][4];  // one per 8-wide slice of D
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_q_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_s + buf * kTileElems;
    const __nv_bfloat16* dot = do_s + buf * kTileElems;
    const float* lse_t = lse_s + buf * kBlockM;
    const float* di_t = di_s + buf * kBlockM;
    const int32_t* seg_t = seg_s + buf * kBlockM;

    // S^T = K Q^T for the warp's 16 keys and the tile's 64 queries
    float st[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ka0[4], ka1[4];
      load_a_fragment(ka0, k_s, warp, lane, half * 2);
      load_a_fragment(ka1, k_s, warp, lane, half * 2 + 1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t qb[4];
        load_b_rows(qb, qt, lane, n, half);
        mma_bf16(st[n], ka0, qb[0], qb[1]);
        mma_bf16(st[n], ka1, qb[2], qb[3]);
      }
    }

    // P^T = exp2(S^T * sm_scale * log2 e - lse * log2 e) on same-segment
    // pairs, exactly 0 elsewhere; bf16 A fragments (rows = keys) for P^T dO
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;  // the tile's queries c and c + 1
      const int sq0 = seg_t[c], sq1 = seg_t[c + 1];
      const float l0 = lse_t[c] * kLog2e, l1 = lse_t[c + 1] * kLog2e;
      st[n][0] = sq0 == seg_k0 ? exp2f(st[n][0] * p.scale_log2 - l0) : 0.f;
      st[n][1] = sq1 == seg_k0 ? exp2f(st[n][1] * p.scale_log2 - l1) : 0.f;
      st[n][2] = sq0 == seg_k1 ? exp2f(st[n][2] * p.scale_log2 - l0) : 0.f;
      st[n][3] = sq1 == seg_k1 ? exp2f(st[n][3] * p.scale_log2 - l1) : 0.f;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(st[n][0], st[n][1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(st[n][2], st[n][3]);
    }

    // dV += P^T dO: 16-query slices against pairs of 8-wide D slices
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t ob[4];
        load_b_cols(ob, dot, lane, kc, dp);
        mma_bf16(dv[dp * 2], pf[kc], ob[0], ob[1]);
        mma_bf16(dv[dp * 2 + 1], pf[kc], ob[2], ob[3]);
      }
    }

    // dP^T = V dO^T
    float dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t va0[4], va1[4];
      load_a_fragment(va0, v_s, warp, lane, half * 2);
      load_a_fragment(va1, v_s, warp, lane, half * 2 + 1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t ob[4];
        load_b_rows(ob, dot, lane, n, half);
        mma_bf16(dpt[n], va0, ob[0], ob[1]);
        mma_bf16(dpt[n], va1, ob[2], ob[3]);
      }
    }

    // dS^T = P^T (dP^T - di) * sm_scale as bf16 A fragments (pf reused)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;
      const float d0 = di_t[c], d1 = di_t[c + 1];
      pf[n >> 1][(n & 1) * 2] = pack_bf16(st[n][0] * (dpt[n][0] - d0) * p.scale,
                                          st[n][1] * (dpt[n][1] - d1) * p.scale);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(st[n][2] * (dpt[n][2] - d0) * p.scale,
                                              st[n][3] * (dpt[n][3] - d1) * p.scale);
    }

    // dK += dS^T Q
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t qb[4];
        load_b_cols(qb, qt, lane, kc, dp);
        mma_bf16(dk[dp * 2], pf[kc], qb[0], qb[1]);
        mma_bf16(dk[dp * 2 + 1], pf[kc], qb[2], qb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // each warp read only its own rows of k_s and v_s: stage dK and dV there
  const long long out = b * p.g_sb + h * p.g_sh + key0 * p.g_ss;
  store_rows(p.dk + out, p.g_ss, k_s, dk, 1.f, 1.f, warp, lane);
  store_rows(p.dv + out, p.g_ss, v_s, dv, 1.f, 1.f, warp, lane);
}

__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;     // [2] tiles
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // [2] tiles
  int32_t* seg_s = reinterpret_cast<int32_t*>(v_s + 2 * kTileElems);  // [2][64]

  const int tiles_m = p.S / kBlockM;
  const int m_tile = blockIdx.x % tiles_m;
  const int bh = blockIdx.x / tiles_m;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = m_tile * kBlockM;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  const int n_tiles = p.S / kBlockN;

  auto load_kv = [&](int t, int buf) {
    const long long row = static_cast<long long>(t) * kBlockN;
    load_tile(k_s + buf * kTileElems, kg + row * p.k_ss, p.k_ss, tid);
    load_tile(v_s + buf * kTileElems, vg + row * p.v_ss, p.v_ss, tid);
    load_row_values(seg_s + buf * kBlockN, segb + row, tid);
  };

  load_tile(q_s, p.q + b * p.q_sb + h * p.q_sh + row0 * p.q_ss, p.q_ss, tid);
  load_tile(do_s, p.dout + b * p.do_sb + h * p.do_sh + row0 * p.do_ss, p.do_ss, tid);
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows: g and g + 8 of the warp's 16
  const int qrow = row0 + warp * 16 + g;
  const long long rows = static_cast<long long>(bh) * p.S + qrow;
  const int seg_q0 = segb[qrow], seg_q1 = segb[qrow + 8];
  const float lse0 = p.lse[rows] * kLog2e, lse1 = p.lse[rows + 8] * kLog2e;
  const float di0 = p.di[rows], di1 = p.di[rows + 8];

  uint32_t qf[4][4], df[4][4];  // Q and dO as A fragments, one per 16-wide slice of D
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        load_a_fragment(qf[kc], q_s, warp, lane, kc);
        load_a_fragment(df[kc], do_s, warp, lane, kc);
      }
    }
    const __nv_bfloat16* kt = k_s + buf * kTileElems;
    const __nv_bfloat16* vt = v_s + buf * kTileElems;
    const int32_t* seg_t = seg_s + buf * kBlockN;

    // S = Q K^T and dP = dO V^T for the warp's 16 queries and 64 keys
    float s[8][4], dpm[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dpm[n][0] = dpm[n][1] = dpm[n][2] = dpm[n][3] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb[4], vb[4];
        load_b_rows(kb, kt, lane, n, half);
        mma_bf16(s[n], qf[half * 2], kb[0], kb[1]);
        mma_bf16(s[n], qf[half * 2 + 1], kb[2], kb[3]);
        load_b_rows(vb, vt, lane, n, half);
        mma_bf16(dpm[n], df[half * 2], vb[0], vb[1]);
        mma_bf16(dpm[n], df[half * 2 + 1], vb[2], vb[3]);
      }
    }

    // dS = P (dP - di) * sm_scale, P exactly 0 across segments; bf16 A
    // fragments (rows = queries) for dS K
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;  // the tile's keys c and c + 1
      const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
      const float p0 = sk0 == seg_q0 ? exp2f(s[n][0] * p.scale_log2 - lse0) : 0.f;
      const float p1 = sk1 == seg_q0 ? exp2f(s[n][1] * p.scale_log2 - lse0) : 0.f;
      const float p2 = sk0 == seg_q1 ? exp2f(s[n][2] * p.scale_log2 - lse1) : 0.f;
      const float p3 = sk1 == seg_q1 ? exp2f(s[n][3] * p.scale_log2 - lse1) : 0.f;
      dsf[n >> 1][(n & 1) * 2] =
          pack_bf16(p0 * (dpm[n][0] - di0) * p.scale, p1 * (dpm[n][1] - di0) * p.scale);
      dsf[n >> 1][(n & 1) * 2 + 1] =
          pack_bf16(p2 * (dpm[n][2] - di1) * p.scale, p3 * (dpm[n][3] - di1) * p.scale);
    }

    // dQ += dS K: 16-key slices against pairs of 8-wide D slices
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t kb[4];
        load_b_cols(kb, kt, lane, kc, dp);
        mma_bf16(dq[dp * 2], dsf[kc], kb[0], kb[1]);
        mma_bf16(dq[dp * 2 + 1], dsf[kc], kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // each warp read only its own rows of q_s: stage dQ there
  store_rows(p.dq + b * p.g_sb + h * p.g_sh + row0 * p.g_ss, p.g_ss, q_s, dq, 1.f, 1.f, warp,
             lane);
}

int fill_params(BwdParams& p, const void* q, const void* k, const void* v, const void* dout,
                const int32_t* seg, const float* lse, const float* di, int B, int H, int S,
                const long long* strides, float sm_scale, long long* blocks) {
  if (S <= 0 || S % kBlockM || S % kBlockN) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<long long>(B) * H * (S / kBlockM);
  if (*blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.seg = seg;
  p.lse = lse;
  p.di = di;
  p.dq = p.dk = p.dv = nullptr;
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

}  // namespace

// strides: 15 values, (b, h, s) strides in elements of q, k, v, dout and of
// the gradient outputs (which share one layout), in that order.  Each entry
// returns the first CUDA error of setting the kernel's shared memory size
// and launching it (0 = launched).  The caller has checked shapes, dtypes
// (bf16, int32 seg, contiguous f32 lse and di), D == 64, S % 128 == 0, a
// contiguous D, strides that are multiples of 8 elements and 16-byte
// aligned pointers.
extern "C" int mfar_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const int32_t* seg,
                                            const float* lse, const float* di, void* dk,
                                            void* dv, int B, int H, int S,
                                            const long long* strides, float sm_scale,
                                            cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  long long blocks = 0;
  int err = fill_params(p, q, k, v, dout, seg, lse, di, B, H, S, strides, sm_scale, &blocks);
  if (err != 0) return err;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  err = static_cast<int>(cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem));
  if (err != 0) return err;
  flash_attention_bwd_dkv_kernel<<<static_cast<unsigned>(blocks), kThreads, kDkvSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mfar_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const int32_t* seg,
                                           const float* lse, const float* di, void* dq, int B,
                                           int H, int S, const long long* strides,
                                           float sm_scale, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  BwdParams p;
  long long blocks = 0;
  int err = fill_params(p, q, k, v, dout, seg, lse, di, B, H, S, strides, sm_scale, &blocks);
  if (err != 0) return err;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  err = static_cast<int>(cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem));
  if (err != 0) return err;
  flash_attention_bwd_dq_kernel<<<static_cast<unsigned>(blocks), kThreads, kDqSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
