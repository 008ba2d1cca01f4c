// Kernel K2: the encoder's flash-attention forward with segment masking,
// written for Hopper (sm_90a), for bf16 at every head dim JAX's kernel
// takes whose rows TMA can read (D a multiple of 8, up to 256).
//
//   O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale, over the keys j with
//                        seg[b,j] == seg[b,i]) . V[b,h]
//
// q/k/v/o are bf16 [B, H, S, D] read and written through their strides
// (D contiguous; the others multiples of 16 bytes), seg is int32 [B, S], S
// is a multiple of 128.  Under training the kernel also writes each row's
// logsumexp of the scaled, masked logits (natural log, f32 [B, H, S]),
// which the backward kernels (flash_attention_bwd.cu up to D = 128,
// flash_attention_simt.cu past it) read.  f32 takes flash_attention_tf32.cu,
// and what TMA cannot read flash_attention_simt.cu.
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
// work and the products add to that time more than they hide under it.  At
// D = 32 (all-MiniLM-L6-v2's heads) the bytes halve (0.1204 ms at [256, 12,
// 512, 32]) while the softmax's work per key does not shrink.
//
// Head dims: the kernel is templated on NS = ceil(D / 64) slabs of 64
// columns, each slab one 64 x 64 tile swizzled by 128 bytes (the
// descriptors, swizzle and k-slice offsets of hopper_common.cuh unchanged).
// The tensor maps span D columns with a 64-wide box, so the columns of the
// last slab past D arrive as zeros: S = sum over slabs of Q_c K_c^T is
// exact, and O's columns past D are 0 and never stored.  D < 64 thus runs
// the products of D = 64: twice the products D = 32 needs, 0.071 ms of
// tensor-core time at [256, 12, 512, 32], under the bytes bound; a copy
// whose S = Q K^T took two of its four k slices ran 0.5945 ms there against
// 0.6335-0.6523 (PERF.md), so they cost 6-9% of the kernel's time,
// not its distance from the bound.  NS = 1 is the D = 64 kernel as it was,
// unchanged in effect: two blocks an SM, kStages 3.  From NS = 2 the O
// accumulators (32 * NS floats a thread) pass two blocks' budget of 128
// registers, so those take one block an SM; NS = 4 keeps 2 stages (Q's 64
// KB and three stages of 128 KB would pass 227 KB).
//
// Design (hopper_pipeline.cuh's block, ring and live-tile list, shared
// with K2b):
//   block = two warpgroups of 64 query rows each (128 rows; S % 128 == 0),
//           two blocks an SM at NS = 1: 16 warps an SM at up to 128
//           registers a thread, where K2b's producer warpgroup would leave
//           80.  The grid is (b, h)-major, so the blocks of one head run
//           together and find its K and V in L2; 128 rows a block halve the
//           K/V tiles each query row costs against 64-row blocks.
//   loads: TMA from 4-D tensor maps over the strided views (no copy),
//        encoded on the host each call.  Each warpgroup's Q slabs arrive
//        once; 64-key tiles of K and V (NS slabs each) with their segment
//        ids stream through an mbarrier ring of kStages stages.  No
//        producer warp: the warpgroup that is last done with a stage loads
//        the tile kStages positions on into it (hopper_pipeline.cuh,
//        release_and_load), so loads stay kStages tiles ahead and the
//        second block on the SM covers one block's start-up.
//   products: S = Q K^T and O += P V on wgmma.m64n64k16 (bf16 in, f32
//        accumulate): S summed over the slabs, Q and K both from their
//        swizzled tiles (K-major), P packed from the S accumulator to bf16
//        A registers (hopper_common.cuh), each V slab an MN-major B into
//        its own O accumulator.
//   overlap: each warpgroup issues tile t's S = Q K^T together with tile
//        t-1's O += P V and runs tile t's softmax while P V is still on the
//        tensor cores (FlashAttention-3's intra-warpgroup pipelining); the
//        other warpgroups on the SM run beside it.
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
// taken as 0 for the subtraction (hopper_pipeline.cuh, softmax_step), so
// no exp2(-inf - -inf) = NaN arises and its sum, output and rescale stay 0.
// Every row has at least its own key, so the end sum is at least 1 and lse
// is finite.

#include <climits>

#include "hopper_pipeline.cuh"

namespace {

struct FwdParams {
  const int32_t* seg;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S] row logsumexp in natural units, or null
  long long o_sb, o_sh, o_ss;
  int H, S, D;
  float scale_log2;  // sm_scale * log2(e)
};

// Stages of the ring of K/V tiles and blocks an SM, by slabs of 64 columns
template <int NS>
struct FwdShape {
  static constexpr int kStages = NS == 4 ? 2 : 3;
  static constexpr int kMinBlocks = NS == 1 ? 2 : 1;
};

// O *= alpha by row (skipped while no row of the warp has a new max), then
// P (f32 in s) as bf16 A registers for P V.
template <int NS>
__device__ __forceinline__ void rescale_and_pack(float (&o)[NS][8][4], const float (&s)[8][4],
                                                 const float (&alpha)[2], uint32_t (&pf)[4][4]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int c = 0; c < NS; ++c) scale_rows(o[c], alpha);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    pf[n >> 1][(n & 1) * 2] = pack_bf16(s[n][0], s[n][1]);
    pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
  }
}

template <int NS>
__global__ void __launch_bounds__(kBlockThreads, FwdShape<NS>::kMinBlocks)
    flash_attention_fwd_kernel(const FwdParams p, const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v) {
  constexpr int kStages = FwdShape<NS>::kStages;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each warpgroup's NS Q slabs; a stage holds K's NS slabs, then V's
  const Smem<kStages, kGroups, 2 * NS> m = carve<kStages, kGroups, 2 * NS>(smem_raw, n_tiles, NS);
  const int blocks = p.S / kRows;
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;

  // a key tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_k, &m.full[stage], h, t * 64, b, 64 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_v, &m.full[stage], h, t * 64, b, 64 * c);
    }
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, kGroups * NS * kTileBytes, [&] {
    for (int w = 0; w < kGroups; ++w) {
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_q, m.own_full, h, blk * kRows + w * 64, b, 64 * c);
      }
    }
  }, bytes, load, 0);
  if (tid == 0) start_loads(m, bytes, load);
  {  // two consumer warpgroups, 64 queries each, which also issue the loads
    const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = blk * kRows + wg * 64;  // the warpgroup's first query
    const int r0 = warp * 16 + g;            // this thread's rows: r0 and r0 + 8
    const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
    const int lo = m.tmin[kGroups * blk + wg], hi = m.tmax[kGroups * blk + wg];
    uint64_t q_desc[NS];
#pragma unroll
    for (int c = 0; c < NS; ++c) q_desc[c] = tile_desc(m.own_tile(c, wg));
    mbar_wait(m.own_full, 0);

    const float neg_inf = __int_as_float(0xff800000);
    float o[NS][8][4], s[8][4], alpha[2];
    uint32_t pf[4][4];  // P of tile `cur` as A registers
    float mrow[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NS; ++c) zero(o[c]);
    const int n_live = *m.n_live;
    const auto k_desc = [&](int i, int c) { return tile_desc(m.stream_tile(i % kStages, c)); };
    const auto v_desc = [&](int i, int c) {
      return tile_desc(m.stream_tile(i % kStages, NS + c));
    };
    const auto softmax = [&](int i) {
      const int t = m.live[i];
      softmax_step(s, reinterpret_cast<const int32_t*>(m.row_values(0, i % kStages)),
                   m.tmin[t], m.tmax[t], seg_q0, seg_q1, t4, p.scale_log2, mrow, l, alpha);
    };
    const auto pv = [&](int i) {  // O += P V, one accumulator a slab
#pragma unroll
      for (int c = 0; c < NS; ++c) gemm_rs<1>(o[c], pf, v_desc(i, c));
    };
    const auto pin_pv = [&] {
#pragma unroll
      for (int c = 0; c < NS; ++c) pin(o[c]);
      pin(pf);
    };
    // cur: the live-list position whose P (in pf) still awaits its P V
    // product, or -1.  Position i's S = Q K^T is issued with cur's P V, and
    // its softmax runs while P V is in flight; a listed tile that misses
    // the warpgroup's rows first drains cur's P V, then releases its stage.
    int cur = -1;
    const auto drain = [&] {
      wgmma_fence();
      pv(cur);
      wgmma_commit();
      wgmma_wait<0>();
      pin_pv();
      release_and_load(m, cur, wg, bytes, load);
      cur = -1;
    };
    for (int i = 0;; ++i) {
      const bool more = i < n_live;
      if (more) m.wait_full(i);
      const bool take = more && m.meets(m.live[i], lo, hi);
      if (take) {
        wgmma_fence();
        gemm_ss_new(s, q_desc[0], k_desc(i, 0));  // S = Q K^T, summed over the slabs
#pragma unroll
        for (int c = 1; c < NS; ++c) gemm_ss_new<true>(s, q_desc[c], k_desc(i, c));
        wgmma_commit();
        if (cur >= 0) {
          pv(cur);  // O += P V of the tile before
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        pin(s);
        softmax(i);
        if (cur >= 0) {
          wgmma_wait<0>();
          pin_pv();
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
    // 1/l, bf16; each slab staged in the warp's own rows of its Q slab (each
    // warp read only its own rows of Q), then 16-byte stores of the columns
    // before D
    __nv_bfloat16* dst = p.o + b * p.o_sb + h * p.o_sh + row0 * p.o_ss;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      store_rows(dst + 64 * c, p.o_ss, m.own_tile(c, wg), o[c], 1.f / l[0], 1.f / l[1], warp,
                 lane, min(kHeadDim, p.D - 64 * c));
    }
  }
}

template <int NS>
int launch_fwd(const FwdParams& p, const void* const bases[3], int B, const long long* strides,
               unsigned blocks, cudaStream_t stream) {
  constexpr int kStages = FwdShape<NS>::kStages;
  // a runtime call first: it makes the device's context current in this
  // thread (remat recomputes the forward on autograd's thread), which
  // cuTensorMapEncodeTiled needs
  const int bytes = smem_bytes<kStages, kGroups, 2 * NS>(p.S, NS);
  int err = static_cast<int>(cudaFuncSetAttribute(
      flash_attention_fwd_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err != 0) return err;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    err = encode_tile_map(&maps[i], bases[i], B, p.H, p.S, strides[3 * i], strides[3 * i + 1],
                          strides[3 * i + 2], p.D);
    if (err != 0) return err;
  }
  flash_attention_fwd_kernel<NS><<<blocks, kBlockThreads, bytes, stream>>>(p, maps[0], maps[1],
                                                                             maps[2]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 values, (b, h, s) strides in elements of q, k, v and o in that
// order.  lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp of the scaled, masked logits (natural log), which the backward
// kernels read.  Returns the first CUDA error of setting the kernel's shared
// memory size, encoding its tensor maps and launching it (0 = launched).
// The caller has checked shapes, dtypes (bf16, int32 seg), a contiguous D,
// strides that are multiples of 8 elements and 16-byte aligned pointers;
// D must be a multiple of 8 up to 256 and S a multiple of 128.
extern "C" int mfar_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const int32_t* seg, void* o, float* lse, int B, int H,
                                        int S, int D, const long long* strides, float sm_scale,
                                        cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (S <= 0 || S % kRows || D < 8 || D > 256 || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(B) * H * (S / kRows);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  FwdParams p;
  p.seg = seg;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale_log2 = sm_scale * kLog2e;
  const void* bases[3] = {q, k, v};
  const unsigned n = static_cast<unsigned>(blocks);
  switch ((D + 63) / 64) {
    case 1: return launch_fwd<1>(p, bases, B, strides, n, stream);
    case 2: return launch_fwd<2>(p, bases, B, strides, n, stream);
    case 3: return launch_fwd<3>(p, bases, B, strides, n, stream);
    default: return launch_fwd<4>(p, bases, B, strides, n, stream);
  }
}
