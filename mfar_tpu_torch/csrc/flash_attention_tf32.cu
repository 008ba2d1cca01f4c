// Kernel K2 in f32: the encoder's flash-attention forward with segment
// masking for f32 inputs, on Hopper's tensor cores (sm_90a) in 3xTF32.
//
//   O[b,h,i] = softmax_j(Q[b,h,i] . K[b,h,j] * sm_scale, over the keys j with
//                        seg[b,j] == seg[b,i]) . V[b,h]
//
// q/k/v/o are f32 [B, H, S, D], D a multiple of 4 up to 256, read and
// written through their strides (D contiguous; the others multiples of 16
// bytes), seg is int32 [B, S], S is a multiple of 128.  Under training the
// kernel also writes each row's logsumexp of the scaled, masked logits
// (natural log, f32 [B, H, S]), which the backward kernels read
// (flash_attention_tf32_bwd.cu).  f32 inputs that neither map below reads
// reach this kernel as zero-padded copies at D rounded up to 4 (the
// "tf32_pad" route of ops/flash_attention.py).
//
// Rows mode (mfar_flash_attention_fwd_tf32_rows, kRowMap; built from this
// source as a library of its own, flash_attention_tf32_rows.cu, so that the
// two modes' sixteen instances build in parallel): at a D that is
// not a multiple of 4 (TinyBERT-4L-312D's 26: rows of 104 bytes a head,
// which no tensor map describes), q, k and v are read through row maps
// (hopper_pipeline.cuh, encode_row_map) over views whose heads lie side by
// side in rows of 16-byte multiples (the H stride D).  TMA starts a box
// only on a 16-byte boundary, so head h's boxes start at h * D rounded
// down to 4 columns, its columns `off` = h * D % 4 columns in, and NS =
// ceil((D + 3) / 32) slabs cover them; past the head's columns a box holds
// its neighbours' (zeros past H * D).  Once Q lands, each warpgroup moves
// its Q rows `off` columns left in shared memory and zeroes them past D;
// each K tile is moved and zeroed so too, by both warpgroups, before its
// first product (shift_rows, flash_common.cuh: the f32 slabs swizzle their
// 16-byte chunks as the bf16 tiles do).  S = Q K^T, stopped at ceil(D / 8)
// k steps, then takes the same products in the same k steps as the
// per-head kernel, exact for any input.  V stays where it landed: O's
// column c sits at accumulator column c + off (each column its own sum
// over the keys) and is stored from there.  S, P, O and the logsumexp are
// bit-equal to the kernel on copies zero-padded to D rounded up to 4
// (where both take as many slabs: D % 32 of 1-29).  O is stored 8 bytes a
// store at even D, else 4.
//
// Replaces the forward of JAX's library Pallas flash_attention at f32:
// _flash_attention_kernel (jax/experimental/pallas/ops/tpu/flash_attention.py
// :331, pl.pallas_call at :758, jax 0.9.0), called at
// mfar_tpu/models/encoder.py:170 (an f32 model: EncoderConfig.tiny, the
// synthetic models, --precision 32).
//
// f32 accuracy on TF32 tensor cores (tf32_common.cuh): each f32 operand
// split into two TF32 parts, each product taken as three TF32 products
// summed in f32.  Both products are done so: S = Q K^T, and O += P V with P
// split the same way.  The result keeps f32 accuracy (held to the f32
// gates: output 2e-5, logsumexp 1e-5), which one TF32 product (10 bits of
// mantissa) would not.
//
// What bounds it: operations.  f32-accurate products cost three TF32
// products at 495 TFLOP/s: at the f32 index build's [256, 12, 512, 64] the
// 140.3 GFLOP over chip_smoke's same-segment pairs take 0.85 ms against
// 0.48 ms for q, k, v and o; with the logsumexp at [96, 12, 512, 64] 0.32
// ms against 0.18 ms of bytes.  (Counted as one f32 FMA each on the CUDA
// cores, 67 TFLOP/s, the same work is 2.0942 ms.)
//
// The instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with
// each warp reading its fragments from shared memory by hand.  wgmma takes
// tf32 operands only K-major: Q and K are (D contiguous), but V ([keys, D],
// D contiguous) is MN-major for O += P V and would need transposing in
// shared memory, and P's accumulator layout is not wgmma's tf32 A layout.
// mma.sync takes any layout: a thread's P entries of keys 2t and 2t + 1
// (the C layout) serve as its A entries of k = t and t + 4 when V's B
// entries are read at the same keys, so P goes from the S accumulator to
// the A registers with no shuffle.  Every fragment read here is free of
// bank conflicts under the 128-byte swizzle.
//
// Design (hopper_pipeline.cuh's ring and live-tile list, as the bf16 K2):
//   slabs: TMA boxes of 64 rows by 32 f32 (128 bytes), swizzled by 128
//        bytes: NS = ceil(D / 32) slabs a 64-row tile, columns past D read
//        as zeros (computed like the rest up to D = 128; past it O's
//        columns past D are skipped, see Tf32Shape).
//   block = kG warpgroups of 64 query rows, 16 a warp: kG = 2 (128 rows)
//        up to D = 128; kG = 1 past it, where 128 rows of Q and two stages
//        of K and V would pass 227 KB; past D = 160 one stage (no load runs
//        ahead: a test-only shape, which no main path runs).  One block an
//        SM: at two, the 128 registers a thread would spill (O's and S's 64
//        floats, the fragments and their splits); measured at the build
//        shape, one block an SM without spills took 3.18 ms, two with 28-56
//        bytes of spills 3.05 ms (PERF.md).
//   loads: each warpgroup's Q slabs once; 64-key tiles of K and V (NS slabs
//        each) with their segment ids through the mbarrier ring (3 stages
//        up to D = 96), loaded by the warpgroup last done with a stage
//        (release_and_load), so loads run kStages - 1 tiles ahead of the
//        products.
//   products: per 64-key tile a warp's 16 x 64 S in 8 n-tiles over D / 8 k
//        steps, three mma.sync a step, then the online softmax (exp2f, in
//        log2 units), then O (16 x D) += P V over 8 k steps of keys.  The
//        splits are integer operations (to_tf32) on values each warp reads
//        from shared memory: every warp splits the K and V values it reads,
//        8 warps the same tile, which with the three products a step is
//        where the time goes (the kernel is bound by its instruction
//        count, not by the tensor cores: 26% of its operations bound at the
//        build shape).
//   skipping: key tiles whose segment-id [min, max] misses the block's rows
//        are never loaded, and a warpgroup skips the products of a loaded
//        tile that misses its own 64 rows (exact for any int32 ids).
//
// Masking: a cross-segment entry of P is exactly 0 (its logit is taken as
// -inf), where JAX adds its finite -0.7 * FLT_MAX and relies on exp
// underflowing; a row that has met none of its keys yet takes its running
// max as 0 for the subtraction (hopper_pipeline.cuh, softmax_step), so no
// NaN arises and its sum, output and rescale stay 0.  Every row has at
// least its own key, so the end sum is at least 1 and lse is finite.

#include <climits>

#include "hopper_pipeline.cuh"
#include "tf32_common.cuh"

namespace {

struct Tf32Params {
  const int32_t* seg;
  float* o;
  float* lse;  // [B, H, S] row logsumexp in natural units, or null
  long long o_sb, o_sh, o_ss;
  int H, S, D;
  float scale_log2;  // sm_scale * log2(e)
  bool pairs;        // O stored two columns a store (8-byte aligned rows), else one
};

// Warpgroups a block and stages of the ring, by slabs of 32 f32 columns
// (shared memory: (kG + 2 * kStages) * NS tiles of 8 KB).  One block an SM:
// at two, the 128 registers a thread would spill.
template <int NS>
struct Tf32Shape {
  static constexpr int kG = NS <= 4 ? 2 : 1;
  static constexpr int kStages = NS <= 3 ? 3 : NS <= 5 ? 2 : 1;
  static constexpr int kThreads = 128 * kG;
  // Past D = 128 O's 4 * NS accumulators leave few registers: the k steps
  // of S = Q K^T go one at a time, and O's 8-column slices past D are
  // skipped.  Up to D = 128 every k step is unrolled and the columns past D
  // (zeros) are computed: a branch a slice costs more than it saves (1.5x
  // the kernel's time at D = 64, which has no such columns).
  static constexpr int kUnrollK = NS <= 4 ? 4 * NS : 1;
  static constexpr bool kSkipPastD = NS > 4;
};

template <int NS, bool kRowMap>
__global__ void __launch_bounds__(Tf32Shape<NS>::kThreads, 1)
    flash_tf32_fwd_kernel(const Tf32Params p, const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v) {
  constexpr int kG = Tf32Shape<NS>::kG, kStages = Tf32Shape<NS>::kStages;
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = p.S / 64;
  // each warpgroup's NS Q slabs; a stage holds K's NS slabs, then V's
  const Smem<kStages, kG, 2 * NS> m = carve<kStages, kG, 2 * NS>(smem_raw, n_tiles, NS);
  const int blocks = p.S / (64 * kG);
  const int blk = blockIdx.x % blocks, bh = blockIdx.x / blocks;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int32_t* segb = p.seg + static_cast<long long>(b) * p.S;
  // the map's head index and the boxes' first column: (h, 0) per head; on
  // row maps (0, h * D rounded down to 4), the head's columns `off` in
  const int off = kRowMap ? (h * p.D) & 3 : 0;
  const int mh = kRowMap ? 0 : h, col0 = kRowMap ? h * p.D - off : 0;

  // a key tile t into a stage: K, V and the keys' segment ids
  const uint32_t bytes = 2 * NS * kTileBytes + 256;
  auto load = [&](int t, int stage) {
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      tma_load_tile(m.stream_tile(stage, c), &map_k, &m.full[stage], mh, t * 64, b,
                    col0 + 32 * c);
      tma_load_tile(m.stream_tile(stage, NS + c), &map_v, &m.full[stage], mh, t * 64, b,
                    col0 + 32 * c);
    }
    bulk_load(m.row_values(0, stage), segb + t * 64, 256, &m.full[stage]);
  };
  set_up(m, segb, n_tiles, blk, kG * NS * kTileBytes, [&] {
    for (int w = 0; w < kG; ++w) {
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        tma_load_tile(m.own_tile(c, w), &map_q, m.own_full, mh, (blk * kG + w) * 64, b,
                      col0 + 32 * c);
      }
    }
  }, bytes, load, 0);
  if (tid == 0) start_loads(m, bytes, load);

  // kG consumer warpgroups, 64 queries each (16 a warp), which also start
  // the loads
  const int warp = wtid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = (blk * kG + wg) * 64;  // the warpgroup's first query
  const int r0 = warp * 16 + g;           // this thread's rows: r0 and r0 + 8
  const int seg_q0 = segb[row0 + r0], seg_q1 = segb[row0 + r0 + 8];
  const int lo = m.tmin[kG * blk + wg], hi = m.tmax[kG * blk + wg];
  mbar_wait(m.own_full, 0);
  // on row maps, Q's head columns to column 0, the rest 0 (in 2-byte units)
  if (kRowMap) {
    shift_rows<NS, 4>(m.own_tile(0, wg), kG * kTileElems, 2 * off, 2 * p.D, warp, lane);
    named_sync(1 + wg, 128);
  }

  const float neg_inf = __int_as_float(0xff800000);
  float o[4 * NS][4];  // the warp's 16 x (32 NS) output, C layout by 8-column slice
  float mrow[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4 * NS; ++e) o[e][0] = o[e][1] = o[e][2] = o[e][3] = 0.f;
  const int n_live = *m.n_live;
  for (int i = 0; i < n_live; ++i) {
    m.wait_full(i);
    const int t = m.live[i], stage = i % kStages;
    if (kRowMap) {  // K's head columns to column 0, the rest 0, by the block
      shift_rows<NS, 4 * kG>(m.stream_tile(stage, 0), kTileElems, 2 * off, 2 * p.D,
                             wg * 4 + warp, lane);
      fence_proxy_async();  // before TMA refills the stage
      named_sync(1 + kG, Tf32Shape<NS>::kThreads);
    }
    if (m.meets(t, lo, hi)) {
      // S = Q K^T: k step kk takes columns 8kk..8kk+7, n-tile j keys 8j..8j+7
      // (on row maps the steps before D only)
      float s[8][4];
      zero(s);
#pragma unroll (Tf32Shape<NS>::kUnrollK)
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kRowMap && 8 * kk >= p.D) break;
        const float* qt = reinterpret_cast<const float*>(m.own_tile(kk >> 2, wg));
        const float* kt = reinterpret_cast<const float*>(m.stream_tile(stage, kk >> 2));
        const int c = 8 * (kk & 3) + t4;
        uint32_t a_hi[4], a_lo[4];
        split(qt[swz32(r0, c)], a_hi[0], a_lo[0]);
        split(qt[swz32(r0 + 8, c)], a_hi[1], a_lo[1]);
        split(qt[swz32(r0, c + 4)], a_hi[2], a_lo[2]);
        split(qt[swz32(r0 + 8, c + 4)], a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b_hi[2], b_lo[2];
          split(kt[swz32(8 * j + g, c)], b_hi[0], b_lo[0]);
          split(kt[swz32(8 * j + g, c + 4)], b_hi[1], b_lo[1]);
          mma_3xtf32(s[j], a_hi, a_lo, b_hi, b_lo);
        }
      }
      float alpha[2];
      softmax_step<true>(s, reinterpret_cast<const int32_t*>(m.row_values(0, stage)), m.tmin[t],
                         m.tmax[t], seg_q0, seg_q1, t4, p.scale_log2, mrow, l, alpha);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) scale_rows(o, alpha);
      // O += P V: k step j takes keys 8j..8j+7, this thread's A entries of
      // k = t4 and t4 + 4 being its P entries of keys 8j + 2t4 and + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t a_hi[4], a_lo[4];
        split(s[j][0], a_hi[0], a_lo[0]);
        split(s[j][2], a_hi[1], a_lo[1]);
        split(s[j][1], a_hi[2], a_lo[2]);
        split(s[j][3], a_hi[3], a_lo[3]);
        const int key = 8 * j + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4 * NS; ++e) {
          if (!Tf32Shape<NS>::kSkipPastD || 8 * e < p.D + off) {
            const float* vt = reinterpret_cast<const float*>(m.stream_tile(stage, NS + (e >> 2)));
            const int c = 8 * (e & 3) + g;
            uint32_t b_hi[2], b_lo[2];
            split(vt[swz32(key, c)], b_hi[0], b_lo[0]);
            split(vt[swz32(key + 1, c)], b_hi[1], b_lo[1]);
            mma_3xtf32(o[e], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
    release_and_load(m, i, wg, bytes, load);
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
  // O / l: two neighbouring columns a store (one where rows start off an
  // 8-byte boundary), those before D; accumulator column c + off holds O's
  // column c (off 0 per head)
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  float* dst = p.o + b * p.o_sb + h * p.o_sh + (row0 + r0) * p.o_ss;
#pragma unroll
  for (int e = 0; e < 4 * NS; ++e) {
    const int c = 8 * e + 2 * t4 - off;
    if (!kRowMap || p.pairs) {  // c even (off is, at an even D)
      if (c >= 0 && c < p.D) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(o[e][0] * inv0, o[e][1] * inv0);
        *reinterpret_cast<float2*>(dst + 8 * p.o_ss + c) =
            make_float2(o[e][2] * inv1, o[e][3] * inv1);
      }
    } else {
      if (c >= 0 && c < p.D) {
        dst[c] = o[e][0] * inv0;
        dst[8 * p.o_ss + c] = o[e][2] * inv1;
      }
      if (c + 1 >= 0 && c + 1 < p.D) {
        dst[c + 1] = o[e][1] * inv0;
        dst[8 * p.o_ss + c + 1] = o[e][3] * inv1;
      }
    }
  }
}

template <int NS, bool kRowMap>
int launch_tf32(const Tf32Params& p, const void* const bases[3], int B, const long long* strides,
                cudaStream_t stream) {
  using Sh = Tf32Shape<NS>;
  const long long blocks = static_cast<long long>(B) * p.H * (p.S / (64 * Sh::kG));
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a runtime call first: it makes the device's context current in this
  // thread (remat recomputes the forward on autograd's thread), which
  // cuTensorMapEncodeTiled needs
  const int bytes = smem_bytes<Sh::kStages, Sh::kG, 2 * NS>(p.S, NS);
  int err = static_cast<int>(cudaFuncSetAttribute(
      flash_tf32_fwd_kernel<NS, kRowMap>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err != 0) return err;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long sb = strides[3 * i], sh = strides[3 * i + 1], ss = strides[3 * i + 2];
    err = kRowMap ? encode_row_map(&maps[i], bases[i], B, p.H, p.S, sb, ss, p.D, true)
                  : encode_tile_map(&maps[i], bases[i], B, p.H, p.S, sb, sh, ss, p.D, true);
    if (err != 0) return err;
  }
  flash_tf32_fwd_kernel<NS, kRowMap>
      <<<static_cast<unsigned>(blocks), Sh::kThreads, bytes, stream>>>(p, maps[0], maps[1],
                                                                        maps[2]);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRowMap>
int launch(const void* q, const void* k, const void* v, const int32_t* seg, void* o, float* lse,
           int B, int H, int S, int D, const long long* strides, float sm_scale,
           cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  // slabs: on row maps the head's columns start up to 3 columns into a box
  const int slabs = kRowMap ? (D + 3 + 31) / 32 : (D + 31) / 32;
  if (S <= 0 || S % 128 || D < 1 || slabs > 8 || (!kRowMap && D % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tf32Params p;
  p.seg = seg;
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale_log2 = sm_scale * kLog2e;
  // float2 stores where every O row of every head starts on an 8-byte boundary
  p.pairs = reinterpret_cast<uintptr_t>(o) % 8 == 0 && ((D | p.o_sb | p.o_sh | p.o_ss) & 1) == 0;
  const void* bases[3] = {q, k, v};
  switch (slabs) {
    case 1: return launch_tf32<1, kRowMap>(p, bases, B, strides, stream);
    case 2: return launch_tf32<2, kRowMap>(p, bases, B, strides, stream);
    case 3: return launch_tf32<3, kRowMap>(p, bases, B, strides, stream);
    case 4: return launch_tf32<4, kRowMap>(p, bases, B, strides, stream);
    case 5: return launch_tf32<5, kRowMap>(p, bases, B, strides, stream);
    case 6: return launch_tf32<6, kRowMap>(p, bases, B, strides, stream);
    case 7: return launch_tf32<7, kRowMap>(p, bases, B, strides, stream);
    default: return launch_tf32<8, kRowMap>(p, bases, B, strides, stream);
  }
}

}  // namespace

// strides: 12 values, (b, h, s) strides in elements of q, k, v and o in that
// order.  lse: null, or a contiguous f32 [B, H, S] that receives each row's
// logsumexp of the scaled, masked logits (natural log), which the backward
// kernels read.  Returns the first CUDA error of setting the kernel's shared
// memory size, encoding its tensor maps and launching it (0 = launched).
// The caller has checked shapes, dtypes (f32, int32 seg), a contiguous D,
// strides that are multiples of 4 elements and 16-byte aligned pointers;
// D must be a multiple of 4 up to 256 and S a multiple of 128.
#ifndef MFAR_TF32_ROWS_ONLY
extern "C" int mfar_flash_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                             const int32_t* seg, void* o, float* lse, int B,
                                             int H, int S, int D, const long long* strides,
                                             float sm_scale, cudaStream_t stream) {
  return launch<false>(q, k, v, seg, o, lse, B, H, S, D, strides, sm_scale, stream);
}
#else  // flash_attention_tf32_rows.cu: the rows mode's instances alone

// The same kernel on row maps, at any D from 1 to 253 (D + 3 columns in
// eight slabs).  The caller has checked, besides, that each of q, k and v
// has the H stride D (its heads side by side in a row) and B and S strides
// that are multiples of 4 elements; o's strides are any.
extern "C" int mfar_flash_attention_fwd_tf32_rows(const void* q, const void* k, const void* v,
                                                  const int32_t* seg, void* o, float* lse, int B,
                                                  int H, int S, int D, const long long* strides,
                                                  float sm_scale, cudaStream_t stream) {
  return launch<true>(q, k, v, seg, o, lse, B, H, S, D, strides, sm_scale, stream);
}
#endif
