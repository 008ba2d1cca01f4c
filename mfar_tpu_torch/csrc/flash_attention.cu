// Kernel K2: the encoder's flash-attention forward with segment masking,
// written for Hopper (sm_90a).
//
//   O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale, over the keys j with
//                        seg[b,j] == seg[b,i]) . V[b,h]
//
// q/k/v/o are bf16 [B, H, S, 64] read and written through their strides
// (D contiguous), seg is int32 [B, S], S is a multiple of 128.  Under
// training the kernel also writes each row's logsumexp of the scaled,
// masked logits (natural log, f32 [B, H, S]), which the backward kernels
// (flash_attention_bwd.cu) read.
//
// Replaces the forward of JAX's library Pallas flash_attention:
// _flash_attention_kernel (jax/experimental/pallas/ops/tpu/flash_attention.py
// :331, pl.pallas_call at :758, jax 0.9.0), called at
// mfar_tpu/models/encoder.py:170.  It computes what that kernel computes,
// not its block structure: the TPU kernel walks a sequential (block_q,
// block_k_major) grid and carries m, l and the output sum in scratch memory
// from one grid step to the next; here blocks run in parallel and each
// loops over the keys itself.
//
// What bounds it: bytes.  At the index build's [256, 12, 512, 64] bf16, q,
// k, v and o are 805 MB, 0.2405 ms at 3.35 TB/s; the two products over the
// same-segment pairs of chip_smoke's lengths are 0.1419 ms at 989 TFLOP/s
// (4 * B * H * S * S * D, all pairs, would be 0.208 ms).  What holds it
// back (PERF.md, PR 5): with no per-tile work (flash_variants.py
// x_nocompute) the loads alone take ~0.29 ms, and the softmax's element
// work and the products add to that time more than they hide under it.
//
// Design (hopper_pipeline.cuh's block, ring and live-tile list, shared
// with K2b):
//   block = two warpgroups of 64 query rows each (128 rows; S % 128 == 0),
//           two blocks an SM: 16 warps an SM at up to 128 registers a
//           thread, where K2b's producer warpgroup would leave 80.  The grid
//           is (b, h)-major, so the blocks of one head run together and find
//           its K and V in L2; 128 rows a block halve the K/V tiles each
//           query row costs against 64-row blocks.
//   loads: TMA from 4-D tensor maps over the strided views (no copy),
//        encoded on the host each call.  Each warpgroup's Q tile arrives
//        once; 64-key tiles of K and V with their segment ids stream through
//        an mbarrier ring of kStages stages.  No producer warp: the
//        warpgroup that is last done with a stage loads the tile kStages
//        positions on into it (hopper_pipeline.cuh, release_and_load), so
//        loads stay kStages tiles ahead and the second block on the SM
//        covers one block's start-up.
//   products: S = Q K^T and O += P V on wgmma.m64n64k16 (bf16 in, f32
//        accumulate): Q and K both from their swizzled tiles (K-major), P
//        packed from the S accumulator to bf16 A registers
//        (hopper_common.cuh), V as an MN-major B.
//   overlap: each warpgroup issues tile t's S = Q K^T together with tile
//        t-1's O += P V and runs tile t's softmax while P V is still on the
//        tensor cores (FlashAttention-3's intra-warpgroup pipelining); the
//        other three warpgroups on the SM run beside it.
//   skipping: key tiles whose segment-id [min, max] misses the block's rows
//        are never loaded, and a warpgroup skips the products of a loaded
//        tile that misses its own 64 rows (exact for any int32 ids; 20.8% of
//        the (warpgroup, key tile) products at chip_smoke's build lengths).
//        A key tile of one segment id masks whole rows, with no per-key
//        compare.
//   exp2: the special-function unit's ex2.approx, in log2 units (logits
//        scaled by sm_scale * log2 e); P is rounded to bf16 next.
//
// Masking: a cross-segment entry of P is exactly 0 (its logit is taken as
// -inf), where JAX adds its finite -0.7 * FLT_MAX and relies on exp
// underflowing.  Since tiles are skipped, a row can meet a tile that holds
// none of its keys while its running max is still -inf (a pad row of a
// straddling query tile against an all-valid key tile): its max is then
// taken as 0 for the subtraction, so no exp2(-inf - -inf) = NaN arises and
// its sum, output and rescale stay 0.  Every row has at least its own key,
// so the end sum is at least 1 and lse is finite.

#include <climits>

#include "hopper_pipeline.cuh"

namespace {

struct FwdParams {
  const int32_t* seg;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S] row logsumexp in natural units, or null
  long long o_sb, o_sh, o_ss;
  int H, S;
  float scale_log2;  // sm_scale * log2(e)
};

constexpr int kStages = 3;  // of the ring of K/V tiles
using Ring = Smem<kStages>;

// One tile's online-softmax step for this thread's two rows (g and g + 8 of
// its warp's 16), in place: S (raw Q . K^T of 64 keys) becomes P = exp2(S *
// scale_log2 - m_new * scale_log2) on the row's segment, exactly 0 off it;
// the running max m (raw units) and this thread's share l of each row's sum
// move on, and alpha is the rescale of the row's earlier output.
__device__ __forceinline__ void softmax_step(float (&s)[8][4], const int32_t* seg_t, int seg_lo,
                                             int seg_hi, int seg_q0, int seg_q1, int t4,
                                             float scale_log2, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  const float neg_inf = __int_as_float(0xff800000);
  if (seg_lo == seg_hi) {  // the tile's keys are of one segment: a row takes all or none
    if (seg_q0 != seg_lo) {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = neg_inf;
    }
    if (seg_q1 != seg_lo) {
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][2] = s[n][3] = neg_inf;
    }
  } else {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;  // the tile's keys c and c + 1
      const int sk0 = seg_t[c], sk1 = seg_t[c + 1];
      s[n][0] = sk0 == seg_q0 ? s[n][0] : neg_inf;
      s[n][1] = sk1 == seg_q0 ? s[n][1] : neg_inf;
      s[n][2] = sk0 == seg_q1 ? s[n][2] : neg_inf;
      s[n][3] = sk1 == seg_q1 ? s[n][3] : neg_inf;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's 64 keys lie across the 4 lanes of a quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row with no key of its own yet: subtract 0, never -inf
    ms[i] = mx[i] == neg_inf ? 0.f : mx[i] * scale_log2;
    alpha[i] = exp2_approx(m[i] * scale_log2 - ms[i]);  // 0 while m was -inf
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = exp2_approx(fmaf(s[n][0], scale_log2, -ms[0]));  // -inf -> 0
    s[n][1] = exp2_approx(fmaf(s[n][1], scale_log2, -ms[0]));
    s[n][2] = exp2_approx(fmaf(s[n][2], scale_log2, -ms[1]));
    s[n][3] = exp2_approx(fmaf(s[n][3], scale_log2, -ms[1]));
    rs[0] += s[n][0] + s[n][1];
    rs[1] += s[n][2] + s[n][3];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// O *= alpha by row (skipped while no row of the warp has a new max), then
// P (f32 in s) as bf16 A registers for P V.
__device__ __forceinline__ void rescale_and_pack(float (&o)[8][4], const float (&s)[8][4],
                                                 const float (&alpha)[2], uint32_t (&pf)[4][4]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    pf[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
    pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 2)
    flash_attention_fwd_kernel(const FwdParams p, const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  const Ring m = carve<kStages>(smem_raw, n_tiles, 1);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // a key tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * kTileBytes + 256;
  auto load = [&](int t, int stage) {
    tma_load_tile(m.stream_tile(stage, 0), &map_k, &m.full[stage], h, t * 64, b);
    tma_load_tile(m.stream_tile(stage, 1), &map_v, &m.full[stage], h, t * 64, b);
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, kGroups * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
      tma_load_tile(m.own_tile(0, w), &map_q, m.own_full, h, blk * kRows + w * 64, b);
    }
  }, bytes, load, 0);
  if (tid == 0) start_loads(m, bytes, load);
  {  // two consumer warpgroups, 64 queries each, which also issue the loads
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = blk * kRows + wg * 64;  // the warpgroup's first query
    const int r0 = warp * 16 + g;            // this thread's rows: r0 and r0 + 8
    const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
    const int lo = m.tmin[kGroups * blk + wg], hi = m.tmax[kGroups * blk + wg];
    __nv_bfloat16* qt = m.own_tile(0, wg);
    const uint64_t q_desc = tile_desc(qt);
    mbar_wait(m.own_full, 0);

    const float neg_inf = __int_as_float(0xff800000);
    float o[8][4], s[8][4], alpha[2];
    uint32_t pf[4][4];  // P of tile `cur` as A registers
    float mrow[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
    zero(o);
    const int n_live = *m.n_live;
    const auto k_desc = [&](int i) { return tile_desc(m.stream_tile(i % kStages, 0)); };
    const auto v_desc = [&](int i) { return tile_desc(m.stream_tile(i % kStages, 1)); };
    const auto softmax = [&](int i) {
      const int t = m.live[i];
      softmax_step(s, reinterpret_cast<const int32_t*>(m.row_values(0, i % kStages)),
                   m.tmin[t], m.tmax[t], seg_q0, seg_q1, t4, p.scale_log2, mrow, l, alpha);
    };
    // cur: the live-list position whose P (in pf) still awaits its P V
    // product, or -1.  Position i's S = Q K^T is issued with cur's P V, and
    // its softmax runs while P V is in flight; a listed tile that misses
    // the warpgroup's rows first drains cur's P V, then releases its stage.
    int cur = -1;
    const auto drain = [&] {
      wgmma_fence();
      gemm_rs<1>(o, pf, v_desc(cur));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      pin(pf);
      release_and_load(m, cur, wg, bytes, load);
      cur = -1;
    };
    for (int i = 0;; ++i) {
      const bool more = i < n_live;
      if (more) m.wait_full(i);
      const bool take = more && m.meets(m.live[i], lo, hi);
      if (take) {
        wgmma_fence();
        gemm_ss_new(s, q_desc, k_desc(i));  // S = Q K^T
        wgmma_commit();
        if (cur >= 0) {
          gemm_rs<1>(o, pf, v_desc(cur));  // O += P V of the tile before
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        pin(s);
        softmax(i);
        if (cur >= 0) {
          wgmma_wait<0>();
          pin(o);
          pin(pf);
          release_and_load(m, cur, wg, bytes, load);
        }
        rescale_and_pack(o, s, alpha, pf);
        cur = i;
      } else {
        if (cur >= 0) drain();
        if (!more) break;
        release_and_load(m, i, wg, bytes, load);  // a tile that misses its rows
      }
    }

    // whole-row sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (p.lse != nullptr && t4 == 0) {
      // logsumexp of the scaled logits: m * scale_log2 + log2 l in log2
      // units, to natural
      float* lse = p.lse + static_cast<long long>(bh) * p.S + row0 + r0;
      lse[0] = (mrow[0] * p.scale_log2 + log2f(l[0])) * kLn2;
      lse[8] = (mrow[1] * p.scale_log2 + log2f(l[1])) * kLn2;
    }
    // 1/l, bf16; staged in the warp's own rows of its Q tile (each warp read
    // only its own rows of Q), then 16-byte stores
    store_rows(p.o + b * p.o_sb + h * p.o_sh + row0 * p.o_ss, p.o_ss, qt, o, 1.f / l[0],
               1.f / l[1], warp, lane);
  }
}

}  // namespace

// strides: 12 values, (b, h, s) strides in elements of q, k, v and o in that
// order.  lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp of the scaled, masked logits (natural log), which the backward
// kernels read.  Returns the first CUDA error of setting the kernel's shared
// memory size, encoding its tensor maps and launching it (0 = launched).
// The caller has checked shapes, dtypes (bf16, int32 seg), D == 64,
// S % 128 == 0, a contiguous D, strides that are multiples of 8 elements and
// 16-byte aligned pointers.
extern "C" int mfar_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int32_t* seg, void* o, float* lse, int B, int H,
                                        int S, const long long* strides, float sm_scale,
                                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || S % kRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * H * (S / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  FwdParams p;
  p.seg = seg;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.H = H;
  p.S = S;
  p.scale_log2 = sm_scale * kLog2e;
  // a runtime call first: it makes the device's context current in this
  // thread (remat recomputes the forward on autograd's thread), which the
  // driver's encoder needs
  const int smem = smem_bytes<kStages>(S, 1);
  int err = static_cast<int>(cudaFuncSetAttribute(
      flash_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  const void* bases[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = encode_tile_map(&maps[i], bases[i], B, H, S, strides[3 * i], strides[3 * i + 1],
                          strides[3 * i + 2]);
    if (err != 0) return err;
  }
  flash_attention_fwd_kernel<<<static_cast<unsigned>(blocks), kBlockThreads, smem, stream>>>(
      p, maps[0], maps[1], maps[2]);
  return static_cast<int>(cudaGetLastError());
}
